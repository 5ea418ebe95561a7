"""Operations and bytes of idefics2 from shapes: the shared LVLM counts
(``benchmark/lib/counting.py``) with the perceiver connector's."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.lib import counting


def connector(s: Dict[str, int], n_valid) -> float:
    """The modality MLP over each image's valid patches, then the perceiver:
    64 latents attend [valid patches ⊕ latents] in each of its layers."""
    n = np.asarray(n_valid, float)
    D, Dv, Fm, Fp = s["D"], s["Dv"], s["Fm"], s["Fp"]
    lat, H, Hkv, Dh = s["latents"], s["Hp"], s["Hkvp"], s["Dhp"]
    modality = 2.0 * n.sum() * (2 * Dv * Fm + Fm * D)
    per_layer = (2.0 * lat * D * H * Dh * len(n)              # q
                 + 2.0 * 2 * (n + lat).sum() * D * Hkv * Dh    # k, v
                 + 4.0 * H * Dh * lat * (n + lat).sum()        # QKᵀ, PV
                 + 2.0 * lat * H * Dh * D * len(n)             # o
                 + 2.0 * 3 * lat * D * Fp * len(n))            # MLP
    return modality + s["Lp"] * per_layer


def train_step(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    return counting.train_step(s, geo, connector)


def eval_call(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    return counting.eval_call(s, geo, connector)
