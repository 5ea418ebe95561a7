"""A run whose timed path is broken underneath comes out not correct: the
harness's own flow on the CPU at tiny sizes (no card), with each fault that
a cell can have planted in the program, held to the real cells' limits."""

import time

import pytest
import torch

from benchmark.tests import tiny
from benchmark.lib import harness, registry

TRAIN = {"idefics2": "idefics2-8b.mimic-train-8shot",
         "llava_interleave": "llava-interleave-7b.mimic-train-4shot"}
EVAL = "idefics2-8b.vqa-eval-b32"


def run(wl, cfg, limits):
    return harness.run_cell(wl, cfg, 2**31 + 99, 0.3, False, tiny.CPU,
                            time.perf_counter(), limits, dtype=torch.float32)


def broken_step(monkeypatch, fault):
    import mimic_tpu_torch.train.step as step_mod
    make = step_mod.make_train_step

    def patched(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, frozen, batch):
            if fault == "unchanged":
                return state, step(state, frozen, batch)[1]
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, frozen, half)

        return faulty

    monkeypatch.setattr(step_mod, "make_train_step", patched)


@pytest.mark.parametrize("family", sorted(TRAIN))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_bench_train_fault_is_not_correct(monkeypatch, family, fault):
    wl, cfg = tiny.train_cell(family)
    limits = registry.workload(TRAIN[family])["limits"]
    assert run(wl, cfg, limits)["correct"]
    broken_step(monkeypatch, fault)
    r = run(wl, cfg, limits)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["token_altered", "half_answered"])
def test_bench_eval_fault_is_not_correct(monkeypatch, fault):
    import mimic_tpu_torch.models.runner as runner_mod
    from mimic_tpu_torch.models.generate import GenerateResult

    wl, cfg = tiny.eval_cell()
    limits = registry.workload(EVAL)["limits"]
    assert run(wl, cfg, limits)["correct"]
    beam = runner_mod.beam_generate

    def faulty(*args, **kwargs):
        r = beam(*args, **kwargs)
        if fault == "half_answered":
            n = r.tokens.shape[0] // 2
            return GenerateResult(r.tokens[:n], r.scores[:n])
        # each answer altered (at 264 tokens, one altered token's rank is
        # a small draw; at the cells' 32003 its rank exceeds the limit 99 % of the time)
        return GenerateResult((r.tokens + 1) % 256, r.scores)

    monkeypatch.setattr(runner_mod, "beam_generate", faulty)
    r = run(wl, cfg, limits)
    assert not r["correct"], (r["checks"], r["failed"])
