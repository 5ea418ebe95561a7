"""Spans of the benchmark's own code, and the traced window's records.

A span is a named stretch of host time around a call into one layer of the
program (the train step, ``generate``, the runner's processor).  Every run
sums each span's host seconds; a traced run also keeps each span's start and
end on the profiler's clock (the system clock, in ns), so that the trace can
say what the host was doing while the device sat idle.  The traced window
records the device's activity only (CUPTI, no host operator events): the
host runs at its untraced speed.

``Record`` is what a per-layer metric's reader gets: the device operations of
the window (name, start, end, in ns), the host spans, the window's length,
the device's busy time (the union of the operations' spans) and what the
traffic says it did (units, operations, kernel bounds, peak memory).
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .copied import covered_us, kernel_group

Span = Tuple[str, int, int]


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.reset()

    def reset(self) -> None:
        """Forget what set-up spent: the window's spans count from here."""
        self.seconds: Dict[str, float] = defaultdict(float)
        self.marks: List[Span] = []

    @contextmanager
    def span(self, name: str):
        t0, ns0 = time.perf_counter(), time.time_ns()
        yield
        self.seconds[name] += time.perf_counter() - t0
        if self.traced:
            self.marks.append((name, ns0, time.time_ns()))


@dataclass
class Record:
    device_ops: List[Span]
    host_spans: List[Span]
    window_s: float
    busy_s: float
    work: Dict[str, Any] = field(default_factory=dict)
    span_seconds: Dict[str, float] = field(default_factory=dict)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event, from the
    raw records (building ``prof.events()`` would take longer than a run may)."""
    return [(e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns(),
             e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()]


class Capture:
    """torch.profiler around the window: the device's activity on a card (the
    host's operators only where there is no card, for the CPU tests)."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.device = device

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def record(self, window_s: float, work: Dict[str, Any], spans: Spans) -> Record:
        ev = _events(self.prof)
        host = list(spans.marks)
        win = [(s, e) for n, s, e in host if n == "window"]
        lo, hi = win[0] if win else (0, 2**63)
        device = [(n, max(s, lo), min(e, hi)) for n, dev, s, e in ev
                  if dev and e > lo and s < hi]
        busy = covered_us([(s, e) for _, s, e in device]) / 1e9
        return Record(device, host, window_s, busy, dict(work), dict(spans.seconds))


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:120] or name[:120]


def breakdown(rec: Record, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time (by name, with their group)
    and the longest idle gaps of the window, by the host span they fell in."""
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in rec.device_ops:
        by_name[f"{short_name(n)} [{kernel_group(n)}]"] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    win = [(s, e) for n, s, e in rec.host_spans if n == "window"]
    lo, hi = win[0] if win else (0, 0)
    busy, cur = [], None
    for s, e in sorted((s, e) for _, s, e in rec.device_ops):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy.append(cur)
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy.append(cur)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    named = []
    inner = [(n, s, e) for n, s, e in rec.host_spans if n != "window"]
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        around = [x for x in inner if x[1] <= s < x[2]]
        label = max(around, key=lambda x: x[1])[0] if around else "between spans"
        named.append([f"{label} at {(s - lo) / 1e9:.3f} s", (e - s) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
