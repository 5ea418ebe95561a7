"""The program's spans and counters (``mimic_tpu_torch.utils.tracing``).

On the CPU: without a profiler nothing is recorded and no CUDA event is
made; under ``torch.profiler`` a tiny MimIC step records its ``train.*``
tree under one root, with the vision tower under both passes, on kineto's
clock; a tiny beam ``generate`` records the processor, one prefill and a
decode step and a beam step per new token after the first; the counters
follow the batch and the listed sync sites; recording changes no number;
``profile`` writes the spans beside its trace on the same time base; and
``ATTN_PATH_LOG`` keeps only its newest entries.

On a card (``cuda``-marked; this file imports no JAX, so it runs there with
``python -m pytest --noconftest tests/test_torch_spans.py``): a kernel's
device interval lies inside its span's host interval, and ``host_syncs``
over a step of each train family and a beam call equals the syncs
``torch.cuda.set_sync_debug_mode("warn")`` reports.
"""

import dataclasses
import json
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mimic_tpu_torch.config import get_preset
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models.config import tiny_text
from mimic_tpu_torch.models.lvlm import init_lvlm_params
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
from mimic_tpu_torch.shift.params import init_shift_params
from mimic_tpu_torch.train import step as ts
from mimic_tpu_torch.train.collate import TrainCollator
from mimic_tpu_torch.train.optim import build_optimizer, flatten
from mimic_tpu_torch.utils import tracing

CPU = torch.device("cpu")
NEW_TOKENS = 4
TRAIN_STAGES = ("train.record_pass", "train.shift_forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def _fresh_records():
    tracing.reset()
    yield
    tracing.reset()


def tiny_cfg(family, tk):
    """A tiny model whose attention widths the card's kernels take: text head
    dim 128, a 70 px tower of head dim 72 (25 patches an image)."""
    cfg = tiny_text(family, head_dim=128)
    return cfg.replace(
        text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size),
        vision=dataclasses.replace(cfg.vision, hidden_size=144, num_heads=2, image_size=70),
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
        image_seq_len=25 if family == "llava-interleave" else cfg.image_seq_len,
    )


def images(rng, rows, per_row):
    # 56 x 70: every image goes through the resize
    return [[rng.integers(0, 255, (56, 70, 3)).astype(np.uint8) for _ in range(per_row)]
            for _ in range(rows)]


def make_runner(family, device, dtype=torch.float32):
    tk = SimpleTokenizer()
    cfg = tiny_cfg(family, tk)
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), CPU)
    params = {k: _cast(v, dtype) for k, v in params.items()}
    runner = LVLMRunner(cfg, params, tk, device=device, pad_multiple=128)
    enc, _ = get_preset("mimic")
    runner.set_shift(init_shift_params(enc, cfg.text, torch.Generator().manual_seed(1), CPU))
    return runner


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def make_step(runner, attn_impl="xla"):
    """A MimIC step on the runner's model, its first state and a host batch."""
    enc, peft = get_preset("mimic")
    collator = TrainCollator(runner.processor, enc.strategy(), pad_multiple=128)
    rng = np.random.default_rng(3)
    tb = collator({
        "prefix_texts": ["Image:<image> Question: what is this? Answer: a cat\n"
                         "Image:<image> Question: how many? Answer: two\n"] * 2,
        "query_texts": ["Image:<image> Question: what now? Answer:",
                        "Image:<image> Question: who is it? Answer:"],
        "answers": ["a dog", "three"],
        "images": images(rng, 2, 3),
    })
    dev = runner.device
    shift = init_shift_params(enc, runner.cfg.text, torch.Generator().manual_seed(1), CPU)
    tree = {"shift": {k: v.to(dev) for k, v in shift.items()}}
    tx = build_optimizer(tree, lr=peft.lr, weight_decay=1e-3, warmup_steps=1,
                         total_steps=10, grad_clip=1.0)
    step = ts.make_train_step(runner.cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl=attn_impl)
    return step, ts.TrainState(tree, tx.init(tree), 0), tb


def expected_train_counts(tb, state, metrics):
    """``images_encoded``: every pixel slot of both passes; ``host_syncs``:
    the batch's copies, each layer-wise loss's row count, the clip's read and
    two bias corrections a leaf."""
    fields = [k for k, v in vars(tb).items() if v is not None and not k.endswith("_image_keys")]
    slots = int(np.prod(tb.full_pixels.shape[:2]) + np.prod(tb.query_pixels.shape[:2]))
    layer_wise = [k for k in metrics if k.endswith(("_mse_loss", "_cos_sim"))]
    assert layer_wise
    return {"images_encoded": slots, "host_syncs": len(fields) + len(layer_wise) + 1
            + 2 * len(flatten(state.trainable))}


def eval_inputs():
    rng = np.random.default_rng(4)
    texts = ["Image:<image> Question: what is it? Answer:",
             "Image:<image> Question: and what colour is the thing on the left? Answer:"]
    return images(rng, 2, 1), texts


def run_eval(runner):
    ims, texts = eval_inputs()
    return runner.generate(ims, texts, num_beams=3, max_new_tokens=NEW_TOKENS)


def leaves(tree):
    """The tensors of a nested dict, in key order (ints, such as a count, left out)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def recording(activities=(ProfilerActivity.CPU,)):
    return profile(activities=list(activities))


# -- the CPU -------------------------------------------------------------------


def test_spans_record_nothing_and_make_no_event_without_a_profiler(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a span made a CUDA event while nothing records")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tracing.span("a") is tracing.span("b")
    runner = make_runner("idefics2", CPU)
    step, state, tb = make_step(runner)
    step(state, runner.params, ts.to_device_batch(tb, CPU))
    run_eval(runner)
    assert tracing.recorded() == {"spans": [], "counts": {}}


def test_train_step_records_its_stages_under_one_root():
    runner = make_runner("idefics2", CPU)
    step, state, tb = make_step(runner)
    batch, frozen = ts.to_device_batch(tb, CPU), runner.params
    tracing.reset()
    with recording() as prof:
        step(state, frozen, batch)
    spans = tracing.recorded()["spans"]
    named = by_name(spans)
    (root,) = named["train.step"]
    assert root["parent"] is None and root["root"] == root["id"]
    assert {s["root"] for s in spans} == {root["id"]}
    for name in TRAIN_STAGES:
        (s,) = named[name]
        assert s["parent"] == root["id"]
    encodes = named["lvlm.encode_images"]
    assert sorted(s["parent"] for s in encodes) == sorted(
        named[n][0]["id"] for n in ("train.record_pass", "train.shift_forward"))
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["device_ms"] is None  # no card
    children = sum(s["host_ms"] for s in spans if s["parent"] == root["id"])
    assert root["self_host_ms"] == pytest.approx(root["host_ms"] - children)

    # the shared clock: every operator of the step lies inside train.step on
    # kineto's clock, and the record pass's operators inside its span
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    assert ops
    assert all(root["start_ns"] <= s and e <= root["end_ns"] for _, s, e in ops)
    rp = named["train.record_pass"][0]
    assert any(rp["start_ns"] <= s and e <= rp["end_ns"] for _, s, e in ops)


def test_beam_generate_records_the_processor_prefill_and_steps():
    runner = make_runner("idefics2", CPU)
    run_eval(runner)  # warm
    tracing.reset()
    with recording():
        run_eval(runner)
    spans = tracing.recorded()["spans"]
    named = by_name(spans)
    (root,) = named["eval.generate"]
    counts = {n: len(v) for n, v in named.items()}
    assert counts == {"eval.generate": 1, "processor.probe": 1, "processor.encode": 1,
                      "processor.images": 1, "processor.resize": 2, "generate.prefill": 1,
                      "lvlm.encode_images": 1, "generate.decode_step": NEW_TOKENS - 1,
                      "generate.beam": NEW_TOKENS - 1}
    assert {s["root"] for s in spans} == {root["id"]}
    parent = {n: {s["parent"] for s in v} for n, v in named.items()}
    assert parent["processor.images"] == {named["processor.encode"][0]["id"]}
    assert parent["processor.resize"] == {named["processor.images"][0]["id"]}
    assert parent["lvlm.encode_images"] == {named["generate.prefill"][0]["id"]}
    for n in ("processor.probe", "processor.encode", "generate.prefill",
              "generate.decode_step", "generate.beam"):
        assert parent[n] == {root["id"]}
    steps = sorted(named["generate.decode_step"] + named["generate.beam"],
                   key=lambda s: s["start_ns"])
    pair = ["generate.decode_step", "generate.beam"]
    assert [s["name"] for s in steps] == pair * (NEW_TOKENS - 1)
    images_ms = named["processor.images"][0]
    resize_ms = sum(s["host_ms"] for s in named["processor.resize"])
    assert images_ms["self_host_ms"] == pytest.approx(images_ms["host_ms"] - resize_ms)


@pytest.mark.parametrize("family", ["idefics2", "llava-interleave"])
def test_counters_follow_the_batch_and_the_sync_sites(family):
    runner = make_runner(family, CPU)
    step, state, tb = make_step(runner)
    tracing.reset()
    with recording():
        _, metrics = step(state, runner.params, ts.to_device_batch(tb, CPU))
    assert tracing.recorded()["counts"] == expected_train_counts(tb, state, metrics)

    tracing.reset()
    ims, texts = eval_inputs()
    with recording():
        run_eval(runner)
    enc = runner.processor(ims, texts, pad_to=128)
    # the runner's copies of the processor's arrays, then the tokens read back
    assert tracing.recorded()["counts"] == {"images_encoded": len(ims),
                                            "host_syncs": len(enc) + 1}


def test_recording_changes_no_number():
    runner = make_runner("idefics2", CPU)
    step, state, tb = make_step(runner)
    batch = ts.to_device_batch(tb, CPU)
    ims, texts = eval_inputs()
    batch_eval = runner.process_input(ims, texts, pad_to=128)
    from mimic_tpu_torch.models.generate import beam_generate

    frozen = runner.params

    def run():
        new, metrics = step(state, frozen, batch)
        out = beam_generate(runner.params, runner.cfg, batch_eval, max_new_tokens=NEW_TOKENS,
                            num_beams=3, eos_token_id=runner.tokenizer.eos_token_id,
                            pad_token_id=runner.tokenizer.pad_token_id, shift=runner.shift)
        return new, metrics, out, run_eval(runner)

    off = run()
    with recording():
        on = run()
    assert tracing.recorded()["spans"]
    for a, b in ((off[0].trainable, on[0].trainable), (off[0].opt_state, on[0].opt_state),
                 (off[1], on[1])):
        la, lb = leaves(a), leaves(b)
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.equal(off[2].tokens, on[2].tokens) and torch.equal(off[2].scores, on[2].scores)
    assert off[3] == on[3]


def test_self_time_and_reset():
    with recording():
        with tracing.span("outer", device=False):
            time.sleep(0.002)
            with tracing.span("inner", device=False):
                time.sleep(0.002)
        tracing.count("things", 3)
        tracing.count("things")
    rec = tracing.recorded()
    outer, inner = rec["spans"] if rec["spans"][0]["name"] == "outer" else rec["spans"][::-1]
    assert inner["parent"] == outer["id"] and inner["root"] == outer["id"]
    assert outer["self_host_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    assert outer["self_host_ms"] >= 1.5 and inner["self_host_ms"] >= 1.5
    assert rec["counts"] == {"things": 4}
    tracing.reset()
    assert tracing.recorded() == {"spans": [], "counts": {}}


def test_profile_writes_the_spans_beside_its_trace(tmp_path):
    tracing.count("before")  # not recording: dropped
    with recording():
        tracing.count("earlier")  # another session: profile() resets
    with tracing.profile(str(tmp_path)):
        with tracing.span("outer"):
            with tracing.span("matmul", device=False):
                torch.ones(64, 64) @ torch.ones(64, 64)
            tracing.count("calls", 2)
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    assert spans["otherData"]["counts"] == {"calls": 2}
    ev = {e["name"]: e for e in spans["traceEvents"] if e["ph"] == "X"}
    assert set(ev) == {"outer", "matmul"}
    assert ev["matmul"]["args"]["parent"] == ev["outer"]["args"]["id"]
    mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert mm
    span = ev["matmul"]
    assert all(span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"] for e in mm)


def test_attn_path_log_keeps_its_newest_entries(monkeypatch):
    from mimic_tpu_torch.models.lvlm import LVLMBatch, lvlm_forward

    monkeypatch.setattr(td, "ATTN_PATH_LOG_MAX", 3)
    runner = make_runner("idefics2", CPU)
    ids = torch.full((1, 8), 5, dtype=torch.long)
    td.ATTN_PATH_LOG.clear()
    for _ in range(5):
        lvlm_forward(runner.params, runner.cfg,
                     LVLMBatch(input_ids=ids, attention_mask=torch.ones_like(ids)))
    assert isinstance(td.ATTN_PATH_LOG, list) and td.ATTN_PATH_LOG == ["xla"] * 3
    td.ATTN_PATH_LOG.clear()


def test_stage_kernels_ties_each_kernel_to_its_operator_and_stage():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "stage_kernels.py"
    spec = importlib.util.spec_from_file_location("stage_kernels", path)
    sk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sk)
    # (name, is_device, start, end, correlation id, linked id, thread)
    events = [
        ("aten::layer_norm", False, 0, 100, 1, 0, 7),
        ("aten::native_layer_norm", False, 10, 90, 2, 0, 7),
        ("cudaLaunchKernel", False, 20, 25, 50, 0, 7),
        ("aten::add", False, 200, 210, 3, 0, 7),
        ("cuLaunchKernelEx", False, 300, 305, 51, 0, 7),  # a launch through ctypes
        ("void at::native::elementwise_kernel<4>(int)", True, 1000, 3000, 50, 2, 0),
        ("void at::native::elementwise_kernel<4>(int)", True, 4000, 5000, 52, 3, 0),
        ("void mimic::mma::attn_fwd_mma_kernel<128>(int)", True, 6000, 6500, 51, 0, 0),
    ]
    spans = [{"name": "train.record_pass", "start_ns": 0, "end_ns": 150},
             {"name": "train.shift_forward", "start_ns": 250, "end_ns": 400}]
    got = {k["kernel"]: k for k in sk.attribute(events, spans)}
    ew = got["at::native::elementwise_kernel [other]"]
    assert ew["seconds"] == pytest.approx(3e-6)
    assert ew["behind"] == [["aten::layer_norm > aten::native_layer_norm", "train.record_pass",
                             pytest.approx(2e-6)], ["aten::add", "(no span)", pytest.approx(1e-6)]]
    assert got["mimic::mma::attn_fwd_mma_kernel [attention forward kernels]"]["behind"] == [
        ["(no operator)", "train.shift_forward", pytest.approx(5e-7)]]


# -- the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' device events and the sync checks")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_span_encloses_its_kernel_on_the_profilers_clock(cuda_device):
    torch.cuda.synchronize()
    # the device recorded alone, as the benchmark's traced window records it
    with recording((ProfilerActivity.CUDA,)) as prof:
        with tracing.span("sleep"):
            torch.cuda._sleep(10_000_000)  # about 5 ms
            torch.cuda.synchronize()
    (s,) = tracing.recorded()["spans"]
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")]
    start, end = max(kernels, key=lambda k: k[1] - k[0])
    assert end - start > 1e6
    slack = 0.5e6
    assert s["start_ns"] - slack <= start and end <= s["end_ns"] + slack, (s, start, end)
    # the span's two events bracket the kernel on its stream
    assert (end - start) / 1e6 <= s["device_ms"] <= s["host_ms"] + 0.5


def _syncs(run):
    """(host_syncs counted, syncs the sync debug mode reports) over ``run``."""
    tracing.reset()
    with warnings.catch_warnings(record=True) as caught, recording():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own notice, the first time it is set in a process, is no sync)
    reported = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    return tracing.recorded()["counts"].get("host_syncs", 0), len(reported)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["idefics2", "llava-interleave"])
def test_host_syncs_equal_the_sync_debug_modes_count(cuda_device, family):
    runner = make_runner(family, cuda_device, torch.bfloat16)
    step, state, tb = make_step(runner, attn_impl="flash")
    frozen = runner.params
    state, metrics = step(state, frozen, ts.to_device_batch(tb, cuda_device))  # builds the kernels
    run_eval(runner)
    torch.cuda.synchronize()
    counted, reported = _syncs(lambda: step(state, frozen, ts.to_device_batch(tb, cuda_device)))
    assert counted == reported == expected_train_counts(tb, state, metrics)["host_syncs"]
    counted, reported = _syncs(lambda: run_eval(runner))
    assert counted == reported
