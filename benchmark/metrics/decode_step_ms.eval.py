"""``decode_step_ms.eval`` (ms): device time of a beam step's forward through
the cache (the program's ``generate.decode_step`` spans), averaged over the
window's steps.  Layer: generation.  Moves ``eval_questions_per_s``."""

from benchmark.lib.program_spans import device_ms_per_span


def read(rec):
    return device_ms_per_span(rec, "calls", "generate.decode_step")
