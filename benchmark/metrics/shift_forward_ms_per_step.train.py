"""``shift_forward_ms_per_step.train`` (ms): device self time of the
program's ``train.shift_forward`` spans (``train/step.py::compute_loss``: the
shift pass's forward with the shift and the losses, its image encoding left
out) per train step.  Layer: decoder passes.  Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "steps", "train.shift_forward", self_time=True)
