"""One run of one cell: set-up, the measured window, the traced records,
the comparison with the reference, and the result line.

The order is fixed: set-up (weights made on the device from the seed, the
program built, the cell's shapes warmed up) is timed as ``setup_s``; the
window runs the traffic for ``seconds``; the peak memory is read; the
program's state is freed; only then does the reference run, so that its
memory and time count in neither.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict, Optional

from . import registry
from .trace import Capture, Spans, breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "mimic_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run may not hold, compared
    whole (``mimic_tpu_torch`` is not ``mimic_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(wl: Dict[str, Any], cfg: Dict[str, Any], seed: int, seconds: float,
             trace: bool, device, t_start: float, limits: Dict[str, float],
             metrics: Optional[Dict[str, Any]] = None, dtype=None) -> Dict[str, Any]:
    """Run the cell once; returns the result object (``correct`` and all)."""
    import torch

    dtype = dtype or getattr(torch, cfg["dtype"])
    spans = Spans(traced=trace)
    traffic = registry.traffic(wl["traffic"]).Traffic(cfg, wl, seed, device, dtype, spans)
    traffic.setup()
    on_card = device.type == "cuda"
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    spans.reset()
    cap = Capture(device) if trace else None
    if cap is not None:
        cap.__enter__()
    with spans.span("window"):
        stats = traffic.window(seconds)
    if cap is not None:
        cap.__exit__(None, None, None)
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    peak_run = max(setup_peak, peak_window)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak_run)}
    result: Dict[str, Any] = {"correct": False, "attempted": stats["attempted"],
                              "failed": stats["failed"], "metrics": {}, "device": device_info}
    metrics = metrics or {"end_to_end": [], "per_layer": []}
    if trace:
        rec = cap.record(stats["elapsed"], dict(stats["work"], peak_window_bytes=peak_window,
                                                device=device.type),
                         spans)
        for m in metrics["per_layer"]:
            value = registry.metric_reader(m["name"]).read(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=rec.busy_s, window_s=rec.window_s)
        result["breakdown"] = breakdown(rec)
    else:
        values = dict(stats["end_to_end"], setup_s=setup_s)
        for m in metrics["end_to_end"]:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    traffic.release()
    readings = traffic.check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
    result["correct"] = bool(ok and stats["failed"] == 0 and stats["attempted"] > 0
                             and set(limits) <= set(readings))
    result["checks"] = checks
    return result


def print_result(result: Dict[str, Any]) -> None:
    """The compared numbers beside their limits as the last lines on standard
    error, then the result as the last line on standard output."""
    for k, v in result.get("checks", {}).items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
