"""SEED-Bench adapter (A–D exact match).  Parity with ``src/dataset_utils/seed_bench.py``
(including the random fallback on invalid predictions; the reference's missing
``import random`` NameError at ``seed_bench.py:91`` is fixed here)."""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from ...evaluate import load_metric
from ..core import postprocess_generation
from ..prefetch import prefetch
from .base import DatasetAdapter


class SeedBenchAdapter(DatasetAdapter):
    support_datasets = ["seed_bench"]

    @property
    def num_role_in_round(self) -> int:
        return 4  # image, question, choices, answer

    @staticmethod
    def metric_key() -> str:
        return "exact_match"

    def extract_answer(self, item: Dict) -> str:
        return item["answer"]

    @property
    def instruction(self):
        return None

    def eval(self, eval_cfg, runner) -> Tuple[List[Dict], Dict]:
        result = []
        metric = load_metric("exact_match")
        dl = self.validation_dataloader(eval_cfg.batch_size)
        iterations = eval_cfg.iterations or len(dl)
        gen_args = vars(eval_cfg.generation)
        rng = random.Random(self.cfg.seed)
        for _, batch in zip(range(iterations), prefetch(dl)):
            predictions = self.get_prediction(
                runner, batch, max_skip_oom=eval_cfg.max_skip_oom, **gen_args
            )
            if predictions is None:  # OOM-skipped batch (budgeted)
                continue
            for pred, context in zip(predictions, batch):
                last_qa = context[-1]
                prediction = postprocess_generation(self.name, pred, stop_words=["\n", "."])
                if str(prediction).upper() not in ["A", "B", "C", "D"]:
                    prediction = rng.choice(["A", "B", "C", "D"])
                metric.add(prediction=prediction, reference=last_qa["answer"])
                result.append(
                    {
                        "question": last_qa["question"],
                        "question_id": last_qa.get("question_id"),
                        "raw_output": pred,
                        "choice_a": last_qa.get("choice_a"),
                        "choice_b": last_qa.get("choice_b"),
                        "choice_c": last_qa.get("choice_c"),
                        "choice_d": last_qa.get("choice_d"),
                        "prediction": prediction,
                        "answer": last_qa["answer"],
                    }
                )
        return self._finish(result, metric)
