"""Analysis entry — parity with reference ``src/analyze.py``.

Scans ``<result_dir>/record/<prefix>*`` and ``<result_dir>/ckpt/<prefix>*``,
extracts the per-epoch metric (dataset ``metric_key``, CIDEr ×100), prints top-k
per run, and reports checkpoints that were never evaluated.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

from ..data.adapters import dataset_mapping


def sort_runname_key(name: str):
    """Numeric-aware sort (reference analyze.py:15-19): epoch-2 < epoch-10."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _dataset_from_runname(runname: str) -> Optional[str]:
    for name in sorted(dataset_mapping, key=len, reverse=True):
        if f"-{name}-" in runname or runname.endswith(f"-{name}"):
            return name
    return None


def extract_metric(record_file: str, metric_key: str) -> Optional[float]:
    try:
        payload = json.load(open(record_file))
    except (json.JSONDecodeError, OSError):
        return None
    result = payload.get("eval_result", payload)
    value = result.get(metric_key)
    if value is None:
        return None
    if metric_key == "CIDEr":
        value = value * 100  # reference analyze.py:67-68
    return float(value)


def analyze(
    prefix: str,
    result_dir: str = "results",
    metric_key: Optional[str] = None,
    topk: int = 1,
    verbose: bool = False,
) -> Dict[str, List[Tuple[str, float]]]:
    """Returns {runname: [(record_name, metric), ...] top-k sorted descending}."""
    record_root = os.path.join(result_dir, "record")
    ckpt_root = os.path.join(result_dir, "ckpt")
    results: Dict[str, List[Tuple[str, float]]] = {}

    run_dirs = []
    if os.path.isdir(record_root):
        run_dirs = sorted(
            (d for d in os.listdir(record_root) if d.startswith(prefix)),
            key=sort_runname_key,
        )
    for runname in run_dirs:
        ds = _dataset_from_runname(runname)
        key = metric_key or (dataset_mapping[ds].metric_key() if ds else None)
        if key is None:
            continue
        entries = []
        run_record_dir = os.path.join(record_root, runname)
        for fname in sorted(os.listdir(run_record_dir), key=sort_runname_key):
            if not fname.endswith(".json"):
                continue
            value = extract_metric(os.path.join(run_record_dir, fname), key)
            if value is not None:
                entries.append((fname[: -len(".json")], value))
        entries.sort(key=lambda kv: kv[1], reverse=True)
        results[runname] = entries[:topk]
        if verbose:
            for name, value in entries:
                print(f"  {runname}/{name}: {value:.3f}")

    # checkpoints that were never evaluated (reference analyze.py:78-93,117-125)
    missing: List[str] = []
    if os.path.isdir(ckpt_root):
        for runname in sorted(os.listdir(ckpt_root), key=sort_runname_key):
            if not runname.startswith(prefix):
                continue
            run_ckpts = {
                d for d in os.listdir(os.path.join(ckpt_root, runname))
                if d.startswith("epoch-")
            }
            evaluated = set()
            run_record_dir = os.path.join(record_root, runname)
            if os.path.isdir(run_record_dir):
                evaluated = {
                    f[: -len(".json")] for f in os.listdir(run_record_dir)
                    if f.endswith(".json")
                }
            for epoch in sorted(run_ckpts - evaluated, key=sort_runname_key):
                missing.append(f"{runname}/{epoch}")

    for runname, entries in results.items():
        top = ", ".join(f"{n}={v:.3f}" for n, v in entries)
        print(f"{runname}: {top if top else '(no records)'}")
    if missing:
        print("checkpoints without records:")
        for item in missing:
            print(f"  {item}")
    return results
