"""``peak_mem_gib.train`` (GiB): ``torch.cuda.max_memory_allocated()`` over
the window of train steps, after ``reset_peak_memory_stats()``.  Layer:
device.  Moves ``train_samples_per_s``."""

from benchmark.lib.readers import peak_gib


def read(rec):
    return peak_gib(rec, "steps")
