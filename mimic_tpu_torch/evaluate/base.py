"""Minimal metric protocol (add/compute), replacing the HF ``evaluate`` dependency.

The reference wraps its metrics in ``evaluate.Metric`` modules
(``testbed/evaluate/metrics/*``); here a metric is a tiny accumulator class with the
same ``add(prediction=..., reference=...)`` / ``compute()`` surface so adapter code
reads identically.
"""

from __future__ import annotations

from typing import Any, Dict, List


class Metric:
    """Accumulate (prediction, reference, **extras) rows then compute a result dict."""

    def __init__(self):
        self._rows: List[Dict[str, Any]] = []

    def add(self, *, prediction, reference, **extras) -> None:
        self._rows.append({"prediction": prediction, "reference": reference, **extras})

    def add_batch(self, *, predictions, references, **extras) -> None:
        keys = list(extras)
        for i, (p, r) in enumerate(zip(predictions, references)):
            self.add(prediction=p, reference=r, **{k: extras[k][i] for k in keys})

    @property
    def rows(self) -> List[Dict[str, Any]]:
        """Accumulated rows (JSON-serializable) — the unit of cross-host merge."""
        return list(self._rows)

    def load_rows(self, rows: List[Dict[str, Any]]) -> None:
        """Replace accumulated rows (merging host-sharded eval partials)."""
        self._rows = list(rows)

    def compute(self) -> Dict[str, Any]:
        if not self._rows:
            raise ValueError(f"{type(self).__name__}.compute() called with no samples")
        result = self._compute(self._rows)
        self._rows = []
        return result

    def _compute(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        raise NotImplementedError
