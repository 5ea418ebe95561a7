"""``device_idle_pct.eval`` (%): 100 - the union of the device operations'
spans over the traced window of generate calls.  Layer: device.  Moves
``eval_questions_per_s``."""

from benchmark.lib.readers import idle_pct


def read(rec):
    return idle_pct(rec, "calls")
