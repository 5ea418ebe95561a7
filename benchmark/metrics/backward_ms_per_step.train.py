"""``backward_ms_per_step.train`` (ms): device time of the program's
``train.backward`` spans (``train/step.py``: ``torch.autograd.grad`` through
the shift pass, the attention backward kernels among it) per train step.
Layer: decoder passes.  Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "steps", "train.backward")
