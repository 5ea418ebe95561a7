"""Operations of the probe family: the shared counts with its one-layer
projector.  Its text tower is counted as the dense tower of its
configuration's widths; the tests read only that the count routes here."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.lib import counting


def connector(s: Dict[str, int], n_valid) -> float:
    return 2.0 * np.asarray(n_valid, float).sum() * s["Dv"] * s["D"]


def train_step(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    return counting.train_step(s, geo, connector)


def eval_call(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    return counting.eval_call(s, geo, connector)
