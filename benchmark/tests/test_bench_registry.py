"""The harness finds every cell, configuration, traffic kind and metric by
name, from files alone, and BENCHMARK.json keeps its documented shape."""

import json
import re

import pytest

from benchmark.tests import tiny
from benchmark.lib import registry
from benchmark.lib.trace import Record

SPEC = registry.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_files(cell):
    wl = registry.workload(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert (entry["config"], entry["traffic"], entry["chips"], entry["why"]) == (
        wl["config"], wl["traffic"], wl["chips"], wl["why"])
    cfg = registry.config(wl["config"])
    assert callable(registry.traffic(wl["traffic"]).Traffic)
    assert callable(registry.traffic(wl["traffic"]).readings)
    fl = registry.flops(cfg["family"])
    assert callable(fl.train_step if wl["traffic"] == "mimic_train" else fl.eval_call)
    assert callable(registry.reference(cfg["family"]).encode_image)
    metrics = registry.cell_metrics(SPEC, cell)
    names = {m["name"] for m in metrics["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert metrics["per_layer"]
    assert all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_bench_metric_reader_reads_nothing_from_an_empty_window(metric):
    rec = Record(device_ops=[], host_spans=[], window_s=1.0, busy_s=0.0, work={})
    assert registry.metric_reader(metric).read(rec) is None


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_bench_config_files(c):
    cfg = json.loads((registry.ROOT / c["file"]).read_text())
    assert (cfg["name"], cfg["source"], cfg["reduced"]) == (c["name"], c["source"], c["reduced"])
    assert c["file"].startswith(SPEC["paths"][0] + "/")


def test_bench_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads") for x in SPEC[k]]
    metrics = [m["name"] for k in ("end_to_end", "per_layer") for m in SPEC[k]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    assert all(NAME.match(n) for n in names + metrics)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["name"].endswith(".train") == (m["moves"] == "train_samples_per_s")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert all(len(w["why"]) <= 200 for w in SPEC["workloads"])
