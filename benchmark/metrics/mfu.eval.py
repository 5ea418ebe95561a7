"""``mfu.eval`` (%): the model operations of the window's generate calls
(vision tower, connector, prefill and the beam steps) over the window and
the 989 TFLOP/s bf16 peak.  Layer: generation (``models/runner.py``,
``models/generate.py``).  Moves ``eval_questions_per_s``."""

from benchmark.lib.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, "calls")
