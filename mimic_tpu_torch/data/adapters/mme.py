"""MME adapter (binary yes/no accuracy).  Parity with ``src/dataset_utils/mme.py``."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...evaluate import load_metric
from ..core import postprocess_generation
from ..prefetch import prefetch
from .base import DatasetAdapter


class MMEAdapter(DatasetAdapter):
    support_datasets = ["mme"]

    @property
    def num_role_in_round(self) -> int:
        return 3

    @staticmethod
    def metric_key() -> str:
        return "accuracy"

    def extract_answer(self, item: Dict) -> str:
        return item["answer"]

    @property
    def instruction(self):
        return 'Provide an answer in "Yes" or "No" to the question. Use the image to answer.'

    def eval(self, eval_cfg, runner) -> Tuple[List[Dict], Dict]:
        result = []
        metric = load_metric("accuracy")
        dl = self.validation_dataloader(eval_cfg.batch_size)
        iterations = eval_cfg.iterations or len(dl)
        gen_args = vars(eval_cfg.generation)
        for _, batch in zip(range(iterations), prefetch(dl)):
            predictions = self.get_prediction(
                runner, batch, max_skip_oom=eval_cfg.max_skip_oom, **gen_args
            )
            if predictions is None:  # OOM-skipped batch (budgeted)
                continue
            for pred, context in zip(predictions, batch):
                last_qa = context[-1]
                gt = last_qa["answer"]
                prediction = postprocess_generation(self.name, pred, stop_words=["\n"])
                metric.add(prediction=prediction, reference=gt.lower() == "yes")
                result.append(
                    {
                        "prediction": prediction,
                        "answer": gt,
                        "question": last_qa["question"],
                        "raw_output": pred,
                        "question_id": last_qa.get("question_id"),
                    }
                )
        return self._finish(result, metric)
