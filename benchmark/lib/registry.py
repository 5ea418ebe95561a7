"""Find a cell's files by name.

Everything that belongs to one configuration, traffic kind, cell or per-layer
metric sits in a file of its own under ``benchmark/``, named after it:

- ``configs/<config>.json``, ``workloads/<cell>.json``;
- ``traffic/<kind>.py``, ``metrics/<metric>.py``, ``flops/<family>.py``,
  ``reference/<family>.py``.

A later PR adds a cell or a metric by adding such files (and its entry in
``BENCHMARK.json``); no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(kind: str) -> ModuleType:
    return _module("traffic", kind)


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def flops(family: str) -> ModuleType:
    return _module("flops", family)


def reference(family: str) -> ModuleType:
    return _module("reference", family)


def benchmark_spec() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell_metrics(spec: Dict[str, Any], cell: str) -> Dict[str, List[Dict[str, Any]]]:
    """The end-to-end and per-layer metrics that ``cell`` reports: those that
    list it under ``workloads``, or have no such list; a per-layer metric
    without one goes wherever the end-to-end metric it moves is reported."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}
