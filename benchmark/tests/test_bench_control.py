"""The control comes out not correct: the reference computed in float8 (the
nearest precision below the configurations' bf16), put in the program's
place, reads far above the program itself, at a size a test run holds (the
program in bf16, as the cells run it).  The cells' limits lie between the
two readings at the cells' own sizes, read on the card by
``benchmark/calibrate.py``; here a limit set the same way (between the two
readings) is failed by the control and kept by the program."""

import math

import pytest
import torch

from benchmark.tests import tiny
from benchmark.lib import registry
from benchmark.lib.trace import Spans

SEED = 2**31 + 3


def separated(prog, ctl):
    """Some number whose control reading is 3x the program's or more; and a
    limit between them (their geometric mean) that the control fails."""
    for k in prog:
        lo, hi = prog[k], ctl[k]
        if hi >= 3 * lo and hi > 0:
            limit = math.sqrt(max(lo, 1e-12) * hi)
            return lo <= limit < hi
    return False


def readings(kind, tr):
    ref = tr.reference()
    ctl = tr.reference("fp8")
    ctl = kind.as_program(ctl) if hasattr(kind, "as_program") else ctl
    return kind.readings(tr.program_readings(), ref), kind.readings(ctl, ref)


@pytest.mark.parametrize("family", ["idefics2", "llava_interleave"])
def test_bench_train_control_fails(family):
    wl, cfg = tiny.train_cell(family)
    kind = registry.traffic("mimic_train")
    tr = kind.Traffic(cfg, wl, SEED, tiny.CPU, torch.bfloat16, Spans(False))
    tr.setup()
    tr.release()
    prog, ctl = readings(kind, tr)
    assert separated(prog, ctl), (prog, ctl)


def test_bench_eval_control_fails():
    wl, cfg = tiny.eval_cell()
    kind = registry.traffic("vqa_eval")
    tr = kind.Traffic(cfg, wl, SEED, tiny.CPU, torch.bfloat16, Spans(False))
    tr.setup()
    tr.window(0.2)
    tr.release()
    prog, ctl = readings(kind, tr)
    assert separated(prog, ctl), (prog, ctl)
