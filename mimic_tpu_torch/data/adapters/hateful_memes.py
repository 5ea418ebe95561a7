"""Hateful Memes adapter (binary accuracy).

The reference ships the retriever/postprocess (``testbed/data/hateful_memes/``)
but no ``src/dataset_utils`` adapter; this completes the surface with the same
keyword→binary postprocess and an accuracy eval loop.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...evaluate import load_metric
from ..core import postprocess_generation
from ..prefetch import prefetch
from .base import DatasetAdapter


class HatefulMemesAdapter(DatasetAdapter):
    support_datasets = ["hateful_memes"]

    @property
    def num_role_in_round(self) -> int:
        return 3

    @staticmethod
    def metric_key() -> str:
        return "accuracy"

    def extract_answer(self, item: Dict) -> str:
        return "yes" if item.get("label") == 1 else "no"

    @property
    def instruction(self):
        return None

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
                last = context[-1]
                prediction = postprocess_generation(self.name, pred, stop_words=["\n"])
                metric.add(prediction=prediction, reference=int(last.get("label", 0)))
                result.append(
                    {
                        "id": last.get("id"),
                        "text": last.get("text"),
                        "raw_output": pred,
                        "prediction": prediction,
                        "label": last.get("label"),
                    }
                )
        return self._finish(result, metric)
