"""Tiny cells for the CPU tests: the port's tiny presets, the real cells'
traffic with shorter texts and smaller images, float32."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import registry  # noqa: E402
from benchmark.reference import mimic  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
TINY_SIZES = [[21, 28], [28, 21], [20, 28], [28, 28], [14, 28]]


def config(family: str):
    name = {"idefics2": "tiny-idefics2", "llava_interleave": "tiny-llava-interleave"}[family]
    return json.loads((DATA / f"{name}.json").read_text())


def train_cell(family: str):
    real = {"idefics2": "idefics2-8b.mimic-train-8shot",
            "llava_interleave": "llava-interleave-7b.mimic-train-4shot"}[family]
    wl = copy.deepcopy(registry.workload(real))
    cfg = config(family)
    p = wl["params"]
    p.update(demos=2, demo_question_chars=[14, 18], demo_answer_chars=[1, 3],
             query_question_chars=[15, 16], answer_chars=[3, 2], pad_multiple=64,
             image_sizes=TINY_SIZES[:3], distinct_batches=4)
    mt = registry.traffic("mimic_train")
    rows = mt.raw_batches(cfg, p, 1)[0]
    fam = registry.reference(family)
    c = mimic.collate(fam, cfg, fam.sizes(cfg), rows, p["pad_multiple"])
    p.update(record_len=c["f_ids"].shape[1], shift_len=c["q_ids"].shape[1])
    return wl, cfg


def eval_cell(family: str = "idefics2"):
    wl = copy.deepcopy(registry.workload("idefics2-8b.vqa-eval-b32"))
    # prompts of one length, unpadded: no row without an attendable key (the
    # port's plain CPU path sums v on such a row where its kernels average it)
    wl["params"].update(questions_per_call=4, pool_calls=3, question_chars=[20] * 4,
                        pad_multiple=1, image_sizes=TINY_SIZES[:4], sample_questions=5,
                        max_new_tokens=4)
    return wl, config(family)
