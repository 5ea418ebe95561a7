"""Operations and bytes of llava-interleave from shapes: the shared LVLM
counts (``benchmark/lib/counting.py``) with the two-layer projector's."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.lib import counting


def connector(s: Dict[str, int], n_valid) -> float:
    """fc1 (vision width → text width) and fc2 over every patch."""
    n = np.asarray(n_valid, float)
    return 2.0 * n.sum() * (s["Dv"] * s["D"] + s["D"] * s["D"])


def train_step(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    return counting.train_step(s, geo, connector)


def eval_call(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    return counting.eval_call(s, geo, connector)
