"""``mfu.train`` (%): the model operations of the window's train steps
(``benchmark/flops/<family>.py``: what the step needs, nothing recomputed)
over the window and the card's 989 TFLOP/s bf16 peak.  Layer: train step
(``train/step.py``, ``models/lvlm.py``).  Moves ``train_samples_per_s``."""

from benchmark.lib.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, "steps")
