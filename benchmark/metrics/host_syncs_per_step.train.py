"""``host_syncs_per_step.train`` (syncs/step): the program's ``host_syncs``
counter per train step: each site where the host waits on the card (the
batch's blocking copies in ``train/step.py::to_device_batch``, the clip's read
of the gradient norm and the bias corrections' copies in ``train/optim.py``).
The benchmark's own loss read-back is not counted.  Layer: train step.
Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import count_per_unit


def read(rec):
    return count_per_unit(rec, "steps", "host_syncs")
