"""``beam_ms_per_step.eval`` (ms): device time of a beam step's bookkeeping
after its logits (the program's ``generate.beam`` spans: log-softmax, top-k,
gathers, the cache's reorder), averaged over the window's steps.  Layer:
generation.  Moves ``eval_questions_per_s``."""

from benchmark.lib.program_spans import device_ms_per_span


def read(rec):
    return device_ms_per_span(rec, "calls", "generate.beam")
