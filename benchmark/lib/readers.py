"""Shared arithmetic of the per-layer metrics' readers (``metrics/*.py``).

A reader returns None where its cell gives it nothing to read: no unit of
its traffic kind in the window, no device trace, no kernel of its list.
"""

from __future__ import annotations

from typing import Iterable, Optional

from .copied import PEAK_OPS
from .trace import Record


def has(rec: Record, unit: str) -> bool:
    """Whether the window ran ``unit`` ("steps" or "calls") at all."""
    return rec.work.get(unit, 0) > 0


def kernel_seconds(rec: Record, names: Iterable[str]) -> float:
    """Summed device time of the operations whose name holds one of ``names``."""
    names = tuple(names)
    return sum(e - s for n, s, e in rec.device_ops if any(k in n for k in names)) / 1e9


def roofline_pct(rec: Record, unit: str, bound_key: str, names: Iterable[str]) -> Optional[float]:
    """The bound of the calls the window needed over the device time of the
    kernels that ran them, in percent."""
    if not has(rec, unit) or bound_key not in rec.work:
        return None
    t = kernel_seconds(rec, names)
    return None if t <= 0 else 100.0 * rec.work[bound_key] / t


def mfu_pct(rec: Record, unit: str) -> Optional[float]:
    """Model operations of the window over its length and the bf16 peak."""
    if not has(rec, unit) or rec.work.get("device") != "cuda":
        return None
    return 100.0 * rec.work["model_flops"] / rec.window_s / PEAK_OPS["bf16"]


def idle_pct(rec: Record, unit: str) -> Optional[float]:
    if not has(rec, unit) or rec.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)


def peak_gib(rec: Record, unit: str) -> Optional[float]:
    if not has(rec, unit) or not rec.work.get("peak_window_bytes"):
        return None
    return rec.work["peak_window_bytes"] / 2**30
