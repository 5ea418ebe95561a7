"""The readers of the program's own spans and counters
(``lib/program_spans.py`` and the metrics that use it): their arithmetic on a
synthetic window with synthetic spans, nothing from a program without the
recorder, and a traced run of each tiny cell on the CPU, where the host
readers read the program and the device readers find nothing."""

import time

import pytest
import torch

from benchmark.tests import tiny
from benchmark.lib import harness, program_spans, registry
from benchmark.lib.trace import Record

MS = 1_000_000
TRAIN = ("image_encode_ms_per_image.train", "record_pass_ms_per_step.train",
         "shift_forward_ms_per_step.train", "backward_ms_per_step.train",
         "optimizer_ms_per_step.train", "host_syncs_per_step.train")
EVAL = ("processor_text_ms_per_q.eval", "processor_resize_ms_per_q.eval",
        "processor_pixels_ms_per_q.eval", "idle_in_processor_pct.eval",
        "image_encode_ms_per_image.eval", "prefill_ms_per_call.eval",
        "decode_step_ms.eval", "beam_ms_per_step.eval")
WINDOW = (500 * MS, 10_500 * MS)


class Spans:
    """Synthetic ``recorded()`` spans: host times in ms from the window's
    start; device ms and self times given (None: a host span)."""

    def __init__(self):
        self.spans = []

    def add(self, name, parent, start, end, dev=None, self_dev=None, self_host=None):
        sid = len(self.spans)
        root = sid if parent is None else self.spans[parent]["root"]
        self.spans.append(dict(
            name=name, id=sid, parent=parent, root=root,
            start_ns=WINDOW[0] + int(start * MS), end_ns=WINDOW[0] + int(end * MS),
            host_ms=end - start, device_ms=dev,
            self_device_ms=dev if self_dev is None and dev is not None else self_dev,
            self_host_ms=end - start if self_host is None else self_host))
        return sid


def record(work, device_ops=()):
    ops = [("k", WINDOW[0] + int(s * MS), WINDOW[0] + int(e * MS)) for s, e in device_ops]
    busy = sum(e - s for _, s, e in ops) / 1e9
    return Record(device_ops=ops, host_spans=[("window", *WINDOW)],
                  window_s=(WINDOW[1] - WINDOW[0]) / 1e9, busy_s=busy, work=work)


def read(name, rec):
    return registry.metric_reader(name).read(rec)


@pytest.fixture
def train_window(monkeypatch):
    sp = Spans()
    # a span of an earlier recording, before the window: left out
    sp.spans.append(dict(name="train.backward", id=-1, parent=None, root=-1, start_ns=0,
                         end_ns=1, host_ms=1e-6, device_ms=1e6, self_device_ms=1e6,
                         self_host_ms=1e-6))
    for k in range(2):
        t = 1000 * k
        step = sp.add("train.step", None, t, t + 200, dev=100.0)
        rp = sp.add("train.record_pass", step, t, t + 50, dev=30.0, self_dev=20.0)
        sp.add("lvlm.encode_images", rp, t, t + 20, dev=10.0)
        sf = sp.add("train.shift_forward", step, t + 60, t + 90, dev=25.0, self_dev=20.0)
        sp.add("lvlm.encode_images", sf, t + 60, t + 70, dev=5.0)
        sp.add("train.backward", step, t + 90, t + 150, dev=30.0)
        sp.add("train.optimizer", step, t + 150, t + 190, dev=10.0)
    prog = {"spans": sp.spans, "counts": {"images_encoded": 6, "host_syncs": 40}}
    monkeypatch.setattr(program_spans, "program", lambda: prog)
    return record({"steps": 2, "units": 4})


@pytest.fixture
def eval_window(monkeypatch):
    sp = Spans()
    sp.spans.append(dict(name="processor.probe", id=-1, parent=None, root=-1, start_ns=0,
                         end_ns=400 * MS, host_ms=400.0, device_ms=None, self_device_ms=None,
                         self_host_ms=400.0))
    for k in range(2):
        t = 5000 * k
        call = sp.add("eval.generate", None, t, t + 200, dev=150.0, self_dev=80.0)
        sp.add("processor.probe", call, t, t + 2, self_host=2.0)
        enc = sp.add("processor.encode", call, t + 2, t + 12)
        images = sp.add("processor.images", enc, t + 3, t + 11, self_host=5.0)
        sp.add("processor.resize", images, t + 4, t + 7)
        pf = sp.add("generate.prefill", call, t + 20, t + 100, dev=50.0, self_dev=30.0)
        sp.add("lvlm.encode_images", pf, t + 20, t + 60, dev=20.0)
        for i in range(3):
            sp.add("generate.decode_step", call, t + 100 + 20 * i, t + 110 + 20 * i, dev=4.0)
            sp.add("generate.beam", call, t + 110 + 20 * i, t + 120 + 20 * i, dev=1.0)
    prog = {"spans": sp.spans, "counts": {"images_encoded": 8, "host_syncs": 12}}
    monkeypatch.setattr(program_spans, "program", lambda: prog)
    # the device is busy until 5 ms into each call's processor, and again from 10 ms
    ops = [(t, t + 5) for t in (0, 5000)] + [(t + 10, t + 300) for t in (0, 5000)]
    return record({"calls": 2, "units": 8}, ops)


def test_bench_train_readers_arithmetic(train_window):
    got = {m: read(m, train_window) for m in TRAIN}
    assert got == pytest.approx({
        "image_encode_ms_per_image.train": (10 + 5) * 2 / 6,
        "record_pass_ms_per_step.train": 20.0,
        "shift_forward_ms_per_step.train": 20.0,
        "backward_ms_per_step.train": 30.0,
        "optimizer_ms_per_step.train": 10.0,
        "host_syncs_per_step.train": 20.0,
    })
    assert all(read(m, train_window) is None for m in EVAL)


def test_bench_eval_readers_arithmetic(eval_window):
    got = {m: read(m, eval_window) for m in EVAL}
    assert got == pytest.approx({
        "processor_text_ms_per_q.eval": (2 + 10 - 8) * 2 / 8,
        "processor_resize_ms_per_q.eval": 3 * 2 / 8,
        "processor_pixels_ms_per_q.eval": 5 * 2 / 8,
        # the host is in the processor for 12 ms a call, the device idle for 5 of them
        "idle_in_processor_pct.eval": 100 * 2 * 5e-3 / 10.0,
        "image_encode_ms_per_image.eval": 20 * 2 / 8,
        "prefill_ms_per_call.eval": 30.0,
        "decode_step_ms.eval": 4.0,
        "beam_ms_per_step.eval": 1.0,
    })
    assert all(read(m, eval_window) is None for m in TRAIN)


def test_bench_idle_overlap_arithmetic():
    a = program_spans.merged([(0, 10), (5, 20), (30, 40)])
    assert a == [(0, 20), (30, 40)]
    b = program_spans.merged([(15, 35), (38, 50)])
    assert program_spans.overlap_ns(a, b) == 5 + 5 + 2
    assert program_spans.overlap_ns(a, []) == 0


@pytest.mark.parametrize("metric", TRAIN + EVAL)
def test_bench_span_readers_read_nothing_without_the_recorder(monkeypatch, metric, request):
    rec = request.getfixturevalue("train_window" if metric in TRAIN else "eval_window")
    assert read(metric, rec) is not None
    monkeypatch.setattr(program_spans, "program", lambda: None)
    assert read(metric, rec) is None


def test_bench_program_without_recorder_is_none(monkeypatch):
    import mimic_tpu_torch.utils.tracing as tracing

    monkeypatch.delattr(tracing, "recorded")
    assert program_spans.program() is None


@pytest.mark.parametrize("cell", ["eval", "idefics2", "llava_interleave"])
def test_bench_traced_tiny_run_reads_the_program(cell):
    from mimic_tpu_torch.utils import tracing

    if cell == "eval":
        (wl, cfg), name = tiny.eval_cell(), "idefics2-8b.vqa-eval-b32"
    else:
        (wl, cfg), name = tiny.train_cell(cell), {
            "idefics2": "idefics2-8b.mimic-train-8shot",
            "llava_interleave": "llava-interleave-7b.mimic-train-4shot"}[cell]
    spec = registry.benchmark_spec()
    tracing.reset()
    r = harness.run_cell(wl, cfg, 2**31 + 5, 0.3, True, tiny.CPU, time.perf_counter(),
                         registry.workload(name)["limits"], registry.cell_metrics(spec, name),
                         dtype=torch.float32)
    tracing.reset()
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    if cell == "eval":
        # host spans read on the CPU; no device time there
        parts = [got[m] for m in EVAL[:3]]
        assert all(v > 0 for v in parts)
        # the program's processor spans enclose the benchmark's own
        assert sum(parts) >= 0.99 * got["preprocess_ms_per_q.eval"]
        assert not set(EVAL[3:]) & set(got)
    else:
        assert set(got) == {"host_syncs_per_step.train"}
        assert got["host_syncs_per_step.train"] == int(got["host_syncs_per_step.train"]) > 7
