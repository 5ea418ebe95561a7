"""``peak_mem_gib.eval`` (GiB): ``torch.cuda.max_memory_allocated()`` over
the window of generate calls, after ``reset_peak_memory_stats()``.  Layer:
device.  Moves ``eval_questions_per_s``."""

from benchmark.lib.readers import peak_gib


def read(rec):
    return peak_gib(rec, "calls")
