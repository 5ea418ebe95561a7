"""VQA adapters: vqav2 / ok_vqa (VQA accuracy) and ocr_vqa (exact match).

Parity with ``src/dataset_utils/vqa.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...evaluate import load_metric
from ..core import postprocess_generation
from ..prefetch import prefetch
from .base import DatasetAdapter

VQA_STOP_WORDS = ["\n", "Question", "Answer", "Image", "Short"]


class VQAAdapter(DatasetAdapter):
    support_datasets = ["vqav2", "ok_vqa", "ocr_vqa"]

    @property
    def num_role_in_round(self) -> int:
        return 3  # image, question, answer

    @staticmethod
    def metric_key() -> str:
        return "overall"

    def extract_answer(self, item: Dict) -> str:
        if self.name == "ocr_vqa":
            return item["answer"]
        return item["answers"][0]["answer"]  # first annotator (vqa.py:83-87)

    @property
    def instruction(self):
        return "Provide an answer to the question. Use the image to answer."

    def eval(self, eval_cfg, runner) -> Tuple[List[Dict], Dict]:
        if self.name == "ocr_vqa":
            return self._eval_exact_match(eval_cfg, runner)
        return self._eval_vqa(eval_cfg, runner)

    def _eval_vqa(self, eval_cfg, runner):
        result = []
        metric = load_metric("vqa_accuracy")
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
                prediction = postprocess_generation(self.name, pred, VQA_STOP_WORDS)
                gt = [a["answer"] for a in last_qa["answers"]]
                metric.add(
                    prediction=prediction,
                    reference=gt,
                    question_types=last_qa.get("question_type"),
                    answer_types=last_qa.get("answer_type"),
                )
                result.append(
                    {
                        "question_id": last_qa.get("question_id"),
                        "raw_output": pred,
                        "question": last_qa["question"],
                        "question_type": last_qa.get("question_type"),
                        "answer_type": last_qa.get("answer_type"),
                        "prediction": prediction,
                        "answers": last_qa["answers"],
                    }
                )
        return self._finish(result, metric)

    def _eval_exact_match(self, eval_cfg, runner):
        result = []
        metric = load_metric("exact_match")
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
                prediction = postprocess_generation(self.name, pred, VQA_STOP_WORDS)
                metric.add(
                    prediction=str(prediction).lower(),
                    reference=last_qa["answer"].lower(),
                )
                result.append(
                    {
                        "question_id": last_qa.get("question_id"),
                        "raw_output": pred,
                        "question": last_qa["question"],
                        "prediction": prediction,
                        "answer": last_qa["answer"],
                    }
                )
        return self._finish(result, metric)
