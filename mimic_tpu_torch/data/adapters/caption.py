"""Caption adapters: coco / flickr (CIDEr).  Parity with ``src/dataset_utils/caption.py``."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...evaluate import load_metric
from ..core import postprocess_generation
from ..prefetch import prefetch
from .base import DatasetAdapter

CAPTION_STOP_WORDS = ["\n", "Caption", "Image", "<", "Short"]


class CaptionAdapter(DatasetAdapter):
    support_datasets = ["coco", "flickr"]

    @property
    def num_role_in_round(self) -> int:
        return 2  # image, caption

    @staticmethod
    def metric_key() -> str:
        return "CIDEr"

    def extract_answer(self, item: Dict) -> str:
        return item["sentences_raw"][0]

    @property
    def instruction(self):
        if self.cfg.is_icl:
            return "provide a short caption of the input image."
        return None

    def eval(self, eval_cfg, runner) -> Tuple[List[Dict], Dict]:
        result = []
        metric = load_metric("cider")
        dl = self.validation_dataloader(eval_cfg.batch_size)
        iterations = eval_cfg.iterations or len(dl)
        gen_args = dict(vars(eval_cfg.generation))
        gen_args["max_new_tokens"] = 20  # caption override (caption.py:72)
        for _, batch in zip(range(iterations), prefetch(dl)):
            predictions = self.get_prediction(
                runner, batch, max_skip_oom=eval_cfg.max_skip_oom, **gen_args
            )
            if predictions is None:  # OOM-skipped batch (budgeted)
                continue
            for pred, context in zip(predictions, batch):
                last_item = context[-1]
                prediction = postprocess_generation(self.name, pred, CAPTION_STOP_WORDS)
                metric.add(prediction=prediction, reference=last_item["sentences_raw"])
                record = {
                    "raw_output": pred,
                    "filename": last_item.get("filename"),
                    "sentences": last_item["sentences_raw"],
                    "prediction": prediction,
                }
                if self.name == "coco":
                    record["cocoid"] = last_item.get("cocoid")
                result.append(record)
        return self._finish(result, metric)
