"""``record_pass_ms_per_step.train`` (ms): device self time of the program's
``train.record_pass`` spans (``train/step.py::compute_loss``: the record
pass's forward without gradients, its image encoding left out) per train
step.  Layer: decoder passes.  Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "steps", "train.record_pass", self_time=True)
