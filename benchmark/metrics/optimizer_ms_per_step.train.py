"""``optimizer_ms_per_step.train`` (ms): device time of the program's
``train.optimizer`` spans (``train/optim.py``: clipping, AdamW's update,
``apply_updates`` and the gradient norm) per train step.  Layer: optimizer.
Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "steps", "train.optimizer")
