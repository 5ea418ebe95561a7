"""``moe_ms_per_step.train`` (ms): device time of the program's ``moe.block``
spans (``models/moe.py``: each routed-expert layer's forward, its router,
sort, grouped products and combine, in both passes) per train step.  None
for a program or a cell without routed experts.  Layer: decoder passes.
Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "steps", "moe.block")
