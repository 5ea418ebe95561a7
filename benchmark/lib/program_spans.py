"""Shared arithmetic of the readers of the program's own spans and counters.

``mimic_tpu_torch.utils.tracing`` records spans (name, host start and end on
the profiler's clock, parent and root ids, device milliseconds between two
CUDA events on the span's stream, self times) and counters, only while a
``torch.profiler`` profile records: in a traced run, the window.  The
readers here take the spans that start inside the window's span of the
harness's ``Record``, and return None where the cell gives them nothing: no
unit of its traffic kind, a program without the recorder, no span of the
name, or (device milliseconds) no card.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from .readers import has
from .trace import Record

Interval = Tuple[int, int]


def program() -> Optional[Dict[str, Any]]:
    """``recorded()`` of the program, or None where it has no recorder."""
    try:
        from mimic_tpu_torch.utils.tracing import recorded
    except ImportError:
        return None
    return recorded()


def _window(rec: Record) -> Interval:
    win = [(s, e) for n, s, e in rec.host_spans if n == "window"]
    return win[0] if win else (0, 2**63)


def window_records(rec: Record, unit: str) -> Optional[Tuple[List[Dict[str, Any]], Dict[str, int]]]:
    """The program's spans that start in the window, and its counters; None
    where the window ran no ``unit`` or the program records nothing."""
    if not has(rec, unit):
        return None
    prog = program()
    if prog is None:
        return None
    lo, hi = _window(rec)
    return [s for s in prog["spans"] if lo <= s["start_ns"] < hi], prog["counts"]


def _device(spans: List[Dict[str, Any]], name: str, self_time: bool) -> Optional[Tuple[float, int]]:
    """(summed device ms, number) of the spans called ``name``; None where
    there is none or one has no device time."""
    key = "self_device_ms" if self_time else "device_ms"
    got = [s[key] for s in spans if s["name"] == name]
    if not got or any(v is None for v in got):
        return None
    return sum(got), len(got)


def device_ms_per_unit(rec: Record, unit: str, name: str,
                       self_time: bool = False) -> Optional[float]:
    """Device ms of the window's ``name`` spans per ``unit`` ("steps", "calls")."""
    got = window_records(rec, unit)
    dev = got and _device(got[0], name, self_time)
    return None if not dev else dev[0] / rec.work[unit]


def device_ms_per_span(rec: Record, unit: str, name: str) -> Optional[float]:
    """Device ms of the window's ``name`` spans per span."""
    got = window_records(rec, unit)
    dev = got and _device(got[0], name, False)
    return None if not dev else dev[0] / dev[1]


def device_ms_per_count(rec: Record, unit: str, name: str, counter: str) -> Optional[float]:
    """Device ms of the window's ``name`` spans per unit of ``counter``."""
    got = window_records(rec, unit)
    dev = got and _device(got[0], name, False)
    if not dev or not got[1].get(counter):
        return None
    return dev[0] / got[1][counter]


def count_per_unit(rec: Record, unit: str, counter: str) -> Optional[float]:
    """The window's ``counter`` per ``unit``."""
    got = window_records(rec, unit)
    if not got or counter not in got[1]:
        return None
    return got[1][counter] / rec.work[unit]


def host_ms_per_question(rec: Record, names: Iterable[str], minus: Iterable[str] = (),
                         self_time: bool = False) -> Optional[float]:
    """Host ms of the window's spans called one of ``names``, less those called
    one of ``minus``, per question answered (the window's ``units``)."""
    got = window_records(rec, "calls")
    if not got:
        return None
    names, minus = set(names), set(minus)
    key = "self_host_ms" if self_time else "host_ms"
    if not any(s["name"] in names for s in got[0]):
        return None
    ms = (sum(s[key] for s in got[0] if s["name"] in names)
          - sum(s["host_ms"] for s in got[0] if s["name"] in minus))
    return ms / rec.work["units"]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Length of the intersection of two unions of disjoint sorted intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(rec: Record, unit: str, prefix: str) -> Optional[float]:
    """The share of the window, in percent, when the device ran no operation
    (the union of ``rec.device_ops``) and the host was in a span whose name
    starts with ``prefix``.  None without a device trace or such a span."""
    if rec.busy_s <= 0:
        return None
    got = window_records(rec, unit)
    if not got:
        return None
    lo, hi = _window(rec)
    host = merged((max(s["start_ns"], lo), min(s["end_ns"], hi)) for s in got[0]
                  if s["name"].startswith(prefix))
    if not host:
        return None
    busy = merged((s, e) for _, s, e in rec.device_ops)
    idle = sum(e - s for s, e in host) - overlap_ns(host, busy)
    return 100.0 * idle / 1e9 / rec.window_s
