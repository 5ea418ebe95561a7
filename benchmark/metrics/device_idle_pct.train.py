"""``device_idle_pct.train`` (%): 100 - the union of the device operations'
spans over the traced window of train steps.  Layer: device.  Moves
``train_samples_per_s``."""

from benchmark.lib.readers import idle_pct


def read(rec):
    return idle_pct(rec, "steps")
